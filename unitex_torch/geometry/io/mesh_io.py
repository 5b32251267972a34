"""Host-side mesh file I/O: OBJ, PLY, GLB/glTF — pure numpy + PIL.

The reference delegates to trimesh/open3d (TextureTools io/mesh_loader.py:22,
io/obj_saver.py, io/link_pbr_to_mesh.py:9-60); those packages are not part of
this framework's dependency set, so the loaders/savers are implemented from
the file-format specs directly.  Capabilities covered:

* OBJ: v/vt/vn/f (polygon fan-triangulated), usemtl/mtllib with map_Kd.
* PLY: ascii + binary_little_endian, vertex positions/normals/colors, faces.
* GLB: binary glTF 2.0 — POSITION/TEXCOORD_0/indices accessors, baseColor
  texture (PNG/JPEG via PIL), multi-primitive scenes concatenated the way
  ``load_whole_mesh`` concatenates trimesh scenes (mesh_loader.py:22-60).

All arrays are numpy (host); convert to jnp at the device boundary.
"""

from __future__ import annotations

import dataclasses
import io as _io
import json
import os
import struct
from typing import Optional

import numpy as np

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


@dataclasses.dataclass
class HostMesh:
    """Host-side (numpy) mesh with optional seam-split UVs and a base-color map."""

    vertices: np.ndarray                       # [V, 3] float32
    faces: np.ndarray                          # [F, 3] int32
    uv: Optional[np.ndarray] = None            # [T, 2] float32, v-up
    faces_uv: Optional[np.ndarray] = None      # [F, 3] int32 into uv
    normals: Optional[np.ndarray] = None       # [V, 3]
    vertex_colors: Optional[np.ndarray] = None  # [V, 3or4] float in [0,1]
    texture: Optional[np.ndarray] = None       # [H, W, 3or4] uint8, row 0 = top
    # PBR maps (glTF metallicRoughnessTexture / normalTexture), uint8
    metallic_roughness: Optional[np.ndarray] = None
    normal_map: Optional[np.ndarray] = None

    @property
    def n_faces(self) -> int:
        return int(self.faces.shape[0])

    @property
    def n_vertices(self) -> int:
        return int(self.vertices.shape[0])


# ---------------------------------------------------------------- OBJ


def _triangulate(poly):
    """Fan-triangulate a polygon index list."""
    return [(poly[0], poly[i], poly[i + 1]) for i in range(1, len(poly) - 1)]


def load_obj(path: str) -> HostMesh:
    vs, vts, vns = [], [], []
    fv, fvt, fvn = [], [], []
    mtllib = None
    usemtl = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            if not line or line[0] == "#":
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                vs.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                vts.append([float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0])
            elif tag == "vn":
                vns.append([float(x) for x in parts[1:4]])
            elif tag == "f":
                corner = []
                for p in parts[1:]:
                    toks = p.split("/")
                    vi = int(toks[0])
                    ti = int(toks[1]) if len(toks) > 1 and toks[1] else 0
                    ni = int(toks[2]) if len(toks) > 2 and toks[2] else 0
                    corner.append((vi, ti, ni))
                for tri in _triangulate(corner):
                    fv.append([c[0] for c in tri])
                    fvt.append([c[1] for c in tri])
                    fvn.append([c[2] for c in tri])
            elif tag == "mtllib":
                mtllib = line.split(None, 1)[1].strip()
            elif tag == "usemtl":
                usemtl = parts[1] if len(parts) > 1 else None

    def fix_index(arr, n):
        a = np.asarray(arr, dtype=np.int64)
        return np.where(a > 0, a - 1, np.where(a < 0, a + n, 0)).astype(np.int32)

    vertices = np.asarray(vs, dtype=np.float32)
    faces = fix_index(fv, len(vs))
    uv = np.asarray(vts, dtype=np.float32) if vts else None
    faces_uv = fix_index(fvt, len(vts)) if (vts and any(any(t) for t in fvt)) else None
    normals = None
    if vns and len(vns) == len(vs):
        normals = np.asarray(vns, dtype=np.float32)

    texture = None
    if mtllib is not None:
        texture = _load_mtl_map_kd(os.path.join(os.path.dirname(path), mtllib), usemtl)
    return HostMesh(vertices, faces, uv, faces_uv, normals, texture=texture)


def _load_mtl_map_kd(mtl_path: str, material: Optional[str]):
    if Image is None or not os.path.exists(mtl_path):
        return None
    current = None
    tex_path = None
    try:
        with open(mtl_path, "r", errors="replace") as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if parts[0] == "newmtl":
                    current = parts[1] if len(parts) > 1 else None
                elif parts[0] == "map_Kd" and (material is None or current == material):
                    tex_path = line.split(None, 1)[1].strip()
        if tex_path:
            full = os.path.join(os.path.dirname(mtl_path), tex_path)
            if os.path.exists(full):
                return np.asarray(Image.open(full).convert("RGB"))
    except OSError:
        return None
    return None


def save_obj(path: str, mesh: HostMesh, texture_name: Optional[str] = None) -> None:
    """Manual OBJ writer (reference io/obj_saver.py behavior: v-up UVs,
    1-based indices, optional mtl + PNG alongside)."""
    base = os.path.splitext(os.path.basename(path))[0]
    lines = []
    has_tex_img = mesh.texture is not None and Image is not None
    if has_tex_img:
        lines.append(f"mtllib {base}.mtl")
    for v in mesh.vertices:
        lines.append(f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}")
    if mesh.uv is not None:
        for t in mesh.uv:
            lines.append(f"vt {t[0]:.8f} {t[1]:.8f}")
    if mesh.normals is not None:
        for n in mesh.normals:
            lines.append(f"vn {n[0]:.8f} {n[1]:.8f} {n[2]:.8f}")
    if has_tex_img:
        lines.append("usemtl material_0")
    fuv = mesh.faces_uv if mesh.faces_uv is not None else mesh.faces
    if mesh.uv is not None:
        for f, t in zip(mesh.faces + 1, fuv + 1):
            lines.append(f"f {f[0]}/{t[0]} {f[1]}/{t[1]} {f[2]}/{t[2]}")
    else:
        for f in mesh.faces + 1:
            lines.append(f"f {f[0]} {f[1]} {f[2]}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    if has_tex_img:
        tex_file = texture_name or f"{base}.png"
        Image.fromarray(mesh.texture).save(os.path.join(os.path.dirname(path) or ".", tex_file))
        with open(os.path.join(os.path.dirname(path) or ".", f"{base}.mtl"), "w") as fh:
            fh.write(
                "newmtl material_0\nKa 1.0 1.0 1.0\nKd 1.0 1.0 1.0\n"
                f"Ks 0.0 0.0 0.0\nmap_Kd {tex_file}\n"
            )


# ---------------------------------------------------------------- PLY


def load_ply(path: str) -> HostMesh:
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError("not a PLY file")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = "ascii"
    elements = []  # (name, count, [(prop_type, prop_name) | ('list', idx_t, cnt_t, name)])
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[1], parts[2]))

    np_types = {
        "char": np.int8, "int8": np.int8, "uchar": np.uint8, "uint8": np.uint8,
        "short": np.int16, "int16": np.int16, "ushort": np.uint16, "uint16": np.uint16,
        "int": np.int32, "int32": np.int32, "uint": np.uint32, "uint32": np.uint32,
        "float": np.float32, "float32": np.float32,
        "double": np.float64, "float64": np.float64,
    }

    parsed = {}
    if fmt == "ascii":
        tokens = body.split()
        pos = 0
        for name, count, props in elements:
            rows = []
            for _ in range(count):
                row = {}
                for p in props:
                    if p[0] == "list":
                        n = int(tokens[pos]); pos += 1
                        row[p[3]] = [float(tokens[pos + i]) for i in range(n)]
                        pos += n
                    else:
                        row[p[1]] = float(tokens[pos]); pos += 1
                rows.append(row)
            parsed[name] = rows
    elif fmt == "binary_little_endian":
        pos = 0
        for name, count, props in elements:
            simple = all(p[0] != "list" for p in props)
            if simple:
                dt = np.dtype([(p[1], np_types[p[0]]) for p in props]).newbyteorder("<")
                arr = np.frombuffer(body, dtype=dt, count=count, offset=pos)
                pos += dt.itemsize * count
                parsed[name] = arr
            else:
                rows = []
                for _ in range(count):
                    row = {}
                    for p in props:
                        if p[0] == "list":
                            cnt_t = np.dtype(np_types[p[1]]).newbyteorder("<")
                            n = int(np.frombuffer(body, cnt_t, 1, pos)[0])
                            pos += cnt_t.itemsize
                            idx_t = np.dtype(np_types[p[2]]).newbyteorder("<")
                            row[p[3]] = np.frombuffer(body, idx_t, n, pos).tolist()
                            pos += idx_t.itemsize * n
                        else:
                            t = np.dtype(np_types[p[0]]).newbyteorder("<")
                            row[p[1]] = float(np.frombuffer(body, t, 1, pos)[0])
                            pos += t.itemsize
                    rows.append(row)
                parsed[name] = rows
    else:
        raise ValueError(f"unsupported PLY format {fmt}")

    def column(rows, key):
        if isinstance(rows, np.ndarray):
            return np.asarray(rows[key]) if key in rows.dtype.names else None
        if rows and key in rows[0]:
            return np.asarray([r[key] for r in rows])
        return None

    vrows = parsed.get("vertex", [])
    vertices = np.stack([column(vrows, k) for k in ("x", "y", "z")], axis=-1).astype(np.float32)
    normals = None
    if column(vrows, "nx") is not None:
        normals = np.stack([column(vrows, k) for k in ("nx", "ny", "nz")], axis=-1).astype(np.float32)
    colors = None
    if column(vrows, "red") is not None:
        colors = np.stack([column(vrows, k) for k in ("red", "green", "blue")], axis=-1).astype(np.float32) / 255.0

    faces = np.zeros((0, 3), dtype=np.int32)
    frows = parsed.get("face", [])
    if len(frows):
        tris = []
        key = "vertex_indices" if (frows and "vertex_indices" in (frows[0] if isinstance(frows, list) else frows.dtype.names)) else "vertex_index"
        for r in (frows if isinstance(frows, list) else []):
            poly = [int(i) for i in r[key]]
            tris.extend(_triangulate(poly))
        faces = np.asarray(tris, dtype=np.int32) if tris else faces
    return HostMesh(vertices, faces, normals=normals, vertex_colors=colors)


def save_ply(path: str, mesh: HostMesh) -> None:
    """binary_little_endian PLY with optional normals/colors."""
    V = mesh.n_vertices
    props = ["property float x", "property float y", "property float z"]
    cols = [mesh.vertices.astype("<f4")]
    if mesh.normals is not None:
        props += ["property float nx", "property float ny", "property float nz"]
        cols.append(mesh.normals.astype("<f4"))
    has_color = mesh.vertex_colors is not None
    if has_color:
        props += ["property uchar red", "property uchar green", "property uchar blue"]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {V}\n" + "\n".join(props) + "\n"
        f"element face {mesh.n_faces}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        vdata = np.concatenate(cols, axis=-1)
        if has_color:
            rgb = np.clip(mesh.vertex_colors[:, :3] * 255.0, 0, 255).astype(np.uint8)
            for i in range(V):
                f.write(vdata[i].tobytes() + rgb[i].tobytes())
        else:
            f.write(vdata.tobytes())
        if mesh.n_faces:
            counts = np.full((mesh.n_faces, 1), 3, dtype=np.uint8)
            fdata = mesh.faces.astype("<i4")
            rec = np.zeros(mesh.n_faces, dtype=np.dtype([("n", np.uint8), ("i", "<i4", 3)]))
            rec["n"] = counts[:, 0]
            rec["i"] = fdata
            f.write(rec.tobytes())


# ---------------------------------------------------------------- GLB


_CT = {5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
       5125: np.uint32, 5126: np.float32}
_CT_SIZE = {k: np.dtype(v).itemsize for k, v in _CT.items()}
_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _read_accessor(gltf, bin_chunk, idx):
    acc = gltf["accessors"][idx]
    bv = gltf["bufferViews"][acc["bufferView"]]
    dtype = _CT[acc["componentType"]]
    ncomp = _NCOMP[acc["type"]]
    count = acc["count"]
    offset = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = bv.get("byteStride", 0)
    itemsize = np.dtype(dtype).itemsize * ncomp
    if stride and stride != itemsize:
        raw = np.frombuffer(bin_chunk, dtype=np.uint8,
                            count=stride * (count - 1) + itemsize, offset=offset)
        out = np.zeros((count, itemsize), dtype=np.uint8)
        for i in range(count):
            out[i] = raw[i * stride: i * stride + itemsize]
        arr = out.view(dtype).reshape(count, ncomp)
    else:
        arr = np.frombuffer(bin_chunk, dtype=dtype, count=count * ncomp, offset=offset)
        arr = arr.reshape(count, ncomp)
    return arr.copy()


def load_glb(path: str) -> HostMesh:
    with open(path, "rb") as f:
        magic, _version, _length = struct.unpack("<III", f.read(12))
        if magic != 0x46546C67:  # 'glTF'
            raise ValueError("not a GLB file")
        chunks = {}
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            clen, ctype = struct.unpack("<II", head)
            chunks[ctype] = f.read(clen)
    gltf = json.loads(chunks[0x4E4F534A])  # 'JSON'
    bin_chunk = chunks.get(0x004E4942, b"")  # 'BIN'

    # node world transforms (column-major matrices or TRS)
    node_tf = {}

    def node_matrix(node):
        if "matrix" in node:
            return np.asarray(node["matrix"], dtype=np.float64).reshape(4, 4).T
        m = np.eye(4)
        if "scale" in node:
            m = m @ np.diag(list(node["scale"]) + [1.0])
        if "rotation" in node:
            x, y, z, w = node["rotation"]
            q = np.asarray([w, x, y, z])
            q = q / np.linalg.norm(q)
            w, x, y, z = q
            r = np.asarray([
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ])
            rm = np.eye(4); rm[:3, :3] = r
            m = rm @ m
        if "translation" in node:
            tm = np.eye(4); tm[:3, 3] = node["translation"]
            m = tm @ m
        return m

    def walk(idx, parent):
        node = gltf.get("nodes", [])[idx]
        m = parent @ node_matrix(node)
        if "mesh" in node:
            node_tf.setdefault(node["mesh"], []).append(m)
        for c in node.get("children", []):
            walk(c, m)

    scene = gltf.get("scenes", [{}])[gltf.get("scene", 0)]
    for root in scene.get("nodes", range(len(gltf.get("nodes", [])))):
        walk(root, np.eye(4))

    all_v, all_f, all_uv, all_fuv = [], [], [], []
    texture_img = None
    v_off = t_off = 0
    for mesh_idx, mesh in enumerate(gltf.get("meshes", [])):
        tfs = node_tf.get(mesh_idx, [np.eye(4)])
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:
                continue
            attrs = prim["attributes"]
            pos = _read_accessor(gltf, bin_chunk, attrs["POSITION"]).astype(np.float32)
            if "indices" in prim:
                idx = _read_accessor(gltf, bin_chunk, prim["indices"]).reshape(-1).astype(np.int64)
            else:
                idx = np.arange(len(pos), dtype=np.int64)
            tri = idx.reshape(-1, 3)
            uv = None
            if "TEXCOORD_0" in attrs:
                uv = _read_accessor(gltf, bin_chunk, attrs["TEXCOORD_0"]).astype(np.float32)
                uv[:, 1] = 1.0 - uv[:, 1]  # glTF v-down -> our v-up
            if texture_img is None and "material" in prim:
                texture_img = _read_gltf_base_color(gltf, bin_chunk, prim["material"], path)
            for tf in tfs:
                p = pos @ tf[:3, :3].T + tf[:3, 3]
                all_v.append(p.astype(np.float32))
                all_f.append(tri + v_off)
                if uv is not None:
                    all_uv.append(uv)
                    all_fuv.append(tri + t_off)
                v_off += len(pos)
                t_off += len(uv) if uv is not None else 0

    vertices = np.concatenate(all_v, axis=0) if all_v else np.zeros((0, 3), np.float32)
    faces = np.concatenate(all_f, axis=0).astype(np.int32) if all_f else np.zeros((0, 3), np.int32)
    uv = np.concatenate(all_uv, axis=0) if all_uv else None
    faces_uv = np.concatenate(all_fuv, axis=0).astype(np.int32) if all_fuv else None
    return HostMesh(vertices, faces, uv, faces_uv, texture=texture_img)


def _read_gltf_base_color(gltf, bin_chunk, mat_idx, path):
    if Image is None:
        return None
    mat = gltf.get("materials", [])[mat_idx]
    pbr = mat.get("pbrMetallicRoughness", {})
    tex_info = pbr.get("baseColorTexture")
    if tex_info is None:
        return None
    tex = gltf["textures"][tex_info["index"]]
    img = gltf["images"][tex["source"]]
    if "bufferView" in img:
        bv = gltf["bufferViews"][img["bufferView"]]
        off = bv.get("byteOffset", 0)
        blob = bin_chunk[off: off + bv["byteLength"]]
        return np.asarray(Image.open(_io.BytesIO(blob)).convert("RGB"))
    if "uri" in img and not img["uri"].startswith("data:"):
        full = os.path.join(os.path.dirname(path), img["uri"])
        if os.path.exists(full):
            return np.asarray(Image.open(full).convert("RGB"))
    return None


def save_glb(path: str, mesh: HostMesh) -> None:
    """Write a single-primitive GLB with optional UVs + base-color PNG
    (equivalent of the reference's trimesh GLB export, link_pbr_to_mesh.py:9-31)."""
    buffers = []

    def add_buffer(arr_bytes, target=None):
        offset = sum(len(b) for b, _ in buffers)
        pad = (-offset) % 4
        if pad:
            buffers[-1] = (buffers[-1][0] + b"\x00" * pad, buffers[-1][1])
            offset += pad
        buffers.append((arr_bytes, target))
        return offset, len(arr_bytes)

    if mesh.uv is not None and mesh.faces_uv is not None:
        # glTF has a single index buffer: expand to per-corner welded layout
        fuv = mesh.faces_uv.reshape(-1)
        fv = mesh.faces.reshape(-1)
        key = fv.astype(np.int64) * (int(fuv.max()) + 1 if fuv.size else 1) + fuv
        uniq, inverse = np.unique(key, return_inverse=True)
        first = np.zeros(len(uniq), dtype=np.int64)
        first[inverse[::-1]] = np.arange(len(fv) - 1, -1, -1)
        positions = mesh.vertices[fv[first]]
        uvs = mesh.uv[fuv[first]].copy()
        uvs[:, 1] = 1.0 - uvs[:, 1]  # our v-up -> glTF v-down
        indices = inverse.astype(np.uint32)
    else:
        positions = mesh.vertices
        uvs = None
        indices = mesh.faces.reshape(-1).astype(np.uint32)

    pos_b = positions.astype("<f4").tobytes()
    idx_b = indices.astype("<u4").tobytes()
    pos_off, pos_len = add_buffer(pos_b, 34962)
    idx_off, idx_len = add_buffer(idx_b, 34963)
    buffer_views = [
        {"buffer": 0, "byteOffset": pos_off, "byteLength": pos_len, "target": 34962},
        {"buffer": 0, "byteOffset": idx_off, "byteLength": idx_len, "target": 34963},
    ]
    accessors = [
        {
            "bufferView": 0, "componentType": 5126, "count": len(positions),
            "type": "VEC3",
            "min": positions.min(axis=0).tolist() if len(positions) else [0, 0, 0],
            "max": positions.max(axis=0).tolist() if len(positions) else [0, 0, 0],
        },
        {"bufferView": 1, "componentType": 5125, "count": len(indices), "type": "SCALAR"},
    ]
    attributes = {"POSITION": 0}
    materials = []
    textures = []
    images = []
    samplers = []

    if uvs is not None:
        uv_b = uvs.astype("<f4").tobytes()
        uv_off, uv_len = add_buffer(uv_b, 34962)
        buffer_views.append(
            {"buffer": 0, "byteOffset": uv_off, "byteLength": uv_len, "target": 34962}
        )
        accessors.append(
            {"bufferView": len(buffer_views) - 1, "componentType": 5126,
             "count": len(uvs), "type": "VEC2"}
        )
        attributes["TEXCOORD_0"] = len(accessors) - 1

    if mesh.texture is not None and Image is not None and uvs is not None:

        def add_texture(img_arr) -> int:
            bio = _io.BytesIO()
            Image.fromarray(img_arr).save(bio, format="PNG")
            img_b = bio.getvalue()
            img_off, img_len = add_buffer(img_b)
            buffer_views.append(
                {"buffer": 0, "byteOffset": img_off, "byteLength": img_len}
            )
            images.append(
                {"bufferView": len(buffer_views) - 1, "mimeType": "image/png"}
            )
            textures.append({"sampler": 0, "source": len(images) - 1})
            return len(textures) - 1

        samplers.append(
            {"magFilter": 9729, "minFilter": 9987, "wrapS": 10497, "wrapT": 10497}
        )
        pbr = {
            "baseColorTexture": {"index": add_texture(mesh.texture)},
            "metallicFactor": 0.0,
            "roughnessFactor": 1.0,
        }
        material = {"pbrMetallicRoughness": pbr, "doubleSided": True}
        # full PBR export (link_pbr_to_mesh capability, io/link_pbr_to_mesh.py)
        if mesh.metallic_roughness is not None:
            pbr["metallicRoughnessTexture"] = {
                "index": add_texture(mesh.metallic_roughness)
            }
            pbr["metallicFactor"] = 1.0
        if mesh.normal_map is not None:
            material["normalTexture"] = {"index": add_texture(mesh.normal_map)}
        materials.append(material)

    primitive = {"attributes": attributes, "indices": 1, "mode": 4}
    if materials:
        primitive["material"] = 0

    total = sum(len(b) for b, _ in buffers)
    pad_total = (-total) % 4
    gltf = {
        "asset": {"version": "2.0", "generator": "unitex_torch"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [primitive]}],
        "buffers": [{"byteLength": total + pad_total}],
        "bufferViews": buffer_views,
        "accessors": accessors,
    }
    if materials:
        gltf.update(materials=materials, textures=textures, images=images, samplers=samplers)

    json_b = json.dumps(gltf, separators=(",", ":")).encode("utf-8")
    json_pad = (-len(json_b)) % 4
    json_b += b" " * json_pad
    bin_b = b"".join(b for b, _ in buffers) + b"\x00" * pad_total
    length = 12 + 8 + len(json_b) + 8 + len(bin_b)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, length))
        f.write(struct.pack("<II", len(json_b), 0x4E4F534A))
        f.write(json_b)
        f.write(struct.pack("<II", len(bin_b), 0x004E4942))
        f.write(bin_b)


# ---------------------------------------------------------------- dispatch


def load_mesh(path: str) -> HostMesh:
    """Load OBJ/PLY/GLB by extension; caps at 10M faces like the reference
    loader (io/mesh_loader.py:22)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        mesh = load_obj(path)
    elif ext == ".ply":
        mesh = load_ply(path)
    elif ext in (".glb", ".gltf"):
        mesh = load_glb(path)
    else:
        raise ValueError(f"unsupported mesh format {ext!r}")
    if mesh.n_faces > 10_000_000:
        raise ValueError(f"mesh too large: {mesh.n_faces} faces (cap 10M)")
    return mesh


def dump_glb(vertices, faces, output_path: str) -> None:
    """Minimal geometry-only GLB dump — the reference's io/dump_glb.py:8-82
    (its hand-rolled pygltflib accessor/bufferView layout is what our
    save_glb already emits)."""
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    save_glb(
        output_path,
        HostMesh(
            vertices=np.asarray(vertices, np.float32),
            faces=np.asarray(faces, np.int64),
        ),
    )


def save_mesh(path: str, mesh: HostMesh) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        save_obj(path, mesh)
    elif ext == ".ply":
        save_ply(path, mesh)
    elif ext == ".glb":
        save_glb(path, mesh)
    else:
        raise ValueError(f"unsupported mesh format {ext!r}")
