"""Turntable video export (port of unitex_tpu/render/video.py): a
120-frame orbit at 1024², perspective fov 49.1°, radius 2.8, textured
render, 15 fps; and the texture-check export :func:`export_turntable`,
an orbit or a three-height sweep written as a video or a frame grid.

Frames render on the mesh's device in batches, are composited on the
background there and quantized to uint8 before the copy to the host.  The
file is an mp4 written by imageio's ffmpeg plugin where that imports, else
a GIF (written with PIL), as the JAX package falls back to a GIF.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from ..camera.generator import generate_intrinsics, generate_orbit_views_c2ws
from ..geometry.io.mesh_io import load_mesh
from ..geometry.mesh import Mesh
from ..utils.image_io import to_uint8_device
from ..utils.precision import resolve_device
from ..utils.timer import CPUTimer
from .renderer import render_views


@torch.no_grad()
def render_orbit_frames(
    mesh: Mesh,
    texture: Optional[torch.Tensor],
    n_frames: int = 120,
    size: int = 1024,
    radius: float = 2.8,
    fov_deg: float = 49.1,
    height: float = 0.0,
    background: float = 1.0,
    batch: int = 10,
    video_type: str = "rgb",
) -> np.ndarray:
    """-> [n_frames, size, size, 3] uint8 frames.  ``video_type``: 'rgb'
    (textured by ``texture`` [Ht, Wt, 3] in [0, 1], or the world normals
    without one), 'normal' or 'ccm' (world positions)."""
    if video_type not in ("rgb", "normal", "ccm"):
        raise ValueError(f"unknown video_type {video_type!r}")
    dev = mesh.vertices.device
    c2ws = generate_orbit_views_c2ws(n_frames + 1, radius=radius, height=height,
                                     device=dev)[:n_frames]
    intr = generate_intrinsics(fov_deg, fov_deg, fov=True, degree=True,
                               device=dev)
    want_tex = video_type == "rgb" and texture is not None
    frames = []
    for i in range(0, n_frames, batch):
        out = render_views(
            mesh, c2ws[i:i + batch], intr, (size, size), perspective=True,
            map_attr=texture if want_tex else None,
            render_uv=want_tex, render_map_attr=want_tex,
            render_world_normal=video_type == "normal" or not want_tex,
            render_world_position=video_type == "ccm",
        )
        if video_type == "ccm":
            rgb = out.world_position * 0.5 + 0.5
        elif want_tex:
            rgb = out.map_attr
        else:
            rgb = out.world_normal * 0.5 + 0.5
        rgb = rgb * out.alpha + background * (1.0 - out.alpha)
        frames.append(to_uint8_device(rgb).cpu())
    return torch.cat(frames).numpy()


def render_height_sweep_frames(
    mesh: Mesh,
    texture: Optional[torch.Tensor],
    n_frames: int = 9,
    size: int = 512,
    radius: float = 2.8,
    video_type: str = "rgb",
) -> np.ndarray:
    """Three stacked orbits at heights r·cos 90°, r·cos 60° and r·cos 30°,
    ``n_frames // 3`` frames each."""
    per = n_frames // 3
    return np.concatenate([
        render_orbit_frames(mesh, texture, n_frames=per, size=size,
                            radius=radius,
                            height=radius * math.cos(math.radians(deg)),
                            video_type=video_type)
        for deg in (90.0, 60.0, 30.0)
    ], axis=0)


def _load_device_mesh(mesh_path: str, dev):
    """A mesh file on ``dev``: (Mesh, its texture [H, W, 3] in [0, 1] or
    None)."""
    host = load_mesh(mesh_path)
    tex = None
    if host.texture is not None:
        tex = torch.from_numpy(np.array(host.texture[..., :3])).to(
            dev).float() / 255.0

    def put(x, dtype):
        return None if x is None else torch.from_numpy(
            np.ascontiguousarray(x, dtype)).to(dev)

    mesh = Mesh(put(host.vertices, np.float32), put(host.faces, np.int64),
                uv=put(host.uv, np.float32), faces_uv=put(host.faces_uv, np.int64))
    return mesh, tex


def export_orbit_video(
    mesh_path: str,
    out_path: str,
    n_frames: int = 120,
    size: int = 1024,
    fps: int = 15,
    radius: float = 2.8,
    fov_deg: float = 49.1,
    video_type: str = "rgb",
    save_camera: bool = False,
    device="cuda",
) -> str:
    """Render the orbit of a mesh file (its texture, if it has one) on
    ``device`` and write it to ``out_path``; returns the path written,
    which ends in ``.gif`` where no mp4 writer imports."""
    mesh, tex = _load_device_mesh(mesh_path, resolve_device(device))
    with CPUTimer("orbit_render"):
        frames = render_orbit_frames(
            mesh, tex, n_frames=n_frames, size=size, radius=radius,
            fov_deg=fov_deg, video_type=video_type,
        )
    with CPUTimer("orbit_write"):
        out_path = _write_video(out_path, frames, fps)
    if save_camera:
        c2ws = generate_orbit_views_c2ws(n_frames + 1, radius=radius,
                                         device="cpu")[:n_frames]
        intr = generate_intrinsics(fov_deg, fov_deg, fov=True, degree=True,
                                   device="cpu")
        np.savez(os.path.splitext(out_path)[0] + "_camera.npz",
                 c2ws=c2ws.numpy(), intrinsics=intr.numpy(),
                 perspective=np.asarray(True))
    return out_path


def _write_video(out_path: str, frames: np.ndarray, fps: int) -> str:
    """[N, H, W, 3] uint8 -> an mp4 through imageio's ffmpeg plugin, or,
    where that does not import, a GIF beside it (PIL; ``1000 / fps`` ms a
    frame, looping).  Returns the path written."""
    try:
        import imageio.v2 as imageio
        import imageio_ffmpeg  # noqa: F401  (the mp4 plugin's backend)
    except ImportError:
        from PIL import Image

        out_path = os.path.splitext(out_path)[0] + ".gif"
        images = [Image.fromarray(f) for f in frames]
        images[0].save(out_path, save_all=True, append_images=images[1:],
                       duration=1000.0 / fps, loop=0)
        return out_path
    imageio.mimwrite(out_path, list(frames), fps=fps, quality=8)
    return out_path


def export_turntable(
    mesh_path: str,
    save_path: str,
    n_frames: int = 8,
    size: int = 512,
    fps: int = 15,
    video_type: str = "rgb",
    height_sweep: bool = False,
    device="cuda",
) -> str:
    """Texture-check export, rendered on ``device``: the extension decides
    the output (.mp4 / .gif a video, .png / .jpg / .webp a near-square
    grid of the frames, padded with white); ``height_sweep`` renders the
    three-height orbit stack instead of one orbit.  The videos go through
    :func:`_write_video` (a GIF where no mp4 writer imports).  Returns the
    path written."""
    ext = os.path.splitext(save_path)[1].lower()
    if ext not in (".png", ".jpg", ".webp", ".mp4", ".gif"):
        raise ValueError(f"unknown turntable format {ext!r}")
    if ext in (".mp4", ".gif") and not height_sweep:
        return export_orbit_video(mesh_path, save_path, n_frames=n_frames,
                                  size=size, fps=fps, video_type=video_type,
                                  device=device)
    mesh, tex = _load_device_mesh(mesh_path, resolve_device(device))
    if height_sweep:
        frames = render_height_sweep_frames(mesh, tex, n_frames=n_frames,
                                            size=size, video_type=video_type)
        n_frames = frames.shape[0]
    else:
        frames = render_orbit_frames(mesh, tex, n_frames=n_frames, size=size,
                                     video_type=video_type)
    if ext in (".mp4", ".gif"):
        return _write_video(save_path, frames, fps)
    cols = int(np.ceil(np.sqrt(n_frames)))
    rows = int(np.ceil(n_frames / cols))
    pad = rows * cols - n_frames
    if pad:
        frames = np.concatenate(
            [frames, np.full((pad,) + frames.shape[1:], 255, np.uint8)])
    grid = (frames.reshape(rows, cols, size, size, 3).transpose(0, 2, 1, 3, 4)
            .reshape(rows * size, cols * size, 3))
    from PIL import Image

    Image.fromarray(grid).save(save_path)
    return save_path
