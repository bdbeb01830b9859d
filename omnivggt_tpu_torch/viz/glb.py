"""Dependency-free binary glTF (.glb) export of predicted scenes
(counterpart of omnivggt_tpu/viz/glb.py; the same bytes).

Confidence-percentile filtering, black/white background masks, optional sky
mask, per-frame filtering, 5-95 percentile scene scale, rainbow-coloured
camera frusta, and alignment to the first camera in OpenGL convention. The
GLB container (JSON chunk + BIN chunk, point-cloud primitive mode 0 +
triangle camera meshes) is written directly: json, struct and numpy only.
"""

from __future__ import annotations

import json
import struct
from typing import List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Minimal GLB container
# ---------------------------------------------------------------------------


def _pad4(b: bytes, pad: bytes) -> bytes:
    return b + pad * ((4 - len(b) % 4) % 4)


def write_glb(
    path: str,
    points: np.ndarray,
    point_colors: np.ndarray,
    meshes: Optional[List[Tuple[np.ndarray, np.ndarray, Tuple[int, int, int]]]] = None,
) -> None:
    """Write a GLB with one POINTS primitive and optional colored triangle
    meshes.

    Args:
        points: (N, 3) float32 positions.
        point_colors: (N, 3) uint8 RGB.
        meshes: list of (vertices (M,3) float32, faces (F,3) uint32, rgb).
    """
    points = np.ascontiguousarray(points, np.float32)
    point_colors = np.ascontiguousarray(point_colors, np.uint8)
    meshes = meshes or []

    bin_parts: List[bytes] = []
    buffer_views = []
    accessors = []
    gltf_meshes = []
    nodes = []

    def add_view(data: bytes, target=None) -> int:
        offset = sum(len(p) for p in bin_parts)
        bin_parts.append(_pad4(data, b"\x00"))
        view = {"buffer": 0, "byteOffset": offset, "byteLength": len(data)}
        if target:
            view["target"] = target
        buffer_views.append(view)
        return len(buffer_views) - 1

    def add_accessor(view, comp_type, count, acc_type, minmax=None) -> int:
        acc = {
            "bufferView": view,
            "componentType": comp_type,
            "count": count,
            "type": acc_type,
        }
        if minmax is not None:
            acc["min"], acc["max"] = minmax
        accessors.append(acc)
        return len(accessors) - 1

    FLOAT, UBYTE, UINT = 5126, 5121, 5125
    ARRAY_BUFFER, ELEMENT_BUFFER = 34962, 34963

    # points primitive (mode 0) with per-vertex colors
    if len(points):
        pos_view = add_view(points.tobytes(), ARRAY_BUFFER)
        pos_acc = add_accessor(
            pos_view,
            FLOAT,
            len(points),
            "VEC3",
            (points.min(0).tolist(), points.max(0).tolist()),
        )
        rgba = np.concatenate(
            [point_colors, np.full((len(point_colors), 1), 255, np.uint8)], axis=1
        )
        col_view = add_view(np.ascontiguousarray(rgba).tobytes(), ARRAY_BUFFER)
        col_acc = add_accessor(col_view, UBYTE, len(rgba), "VEC4")
        accessors[col_acc]["normalized"] = True
        gltf_meshes.append(
            {
                "primitives": [
                    {
                        "attributes": {"POSITION": pos_acc, "COLOR_0": col_acc},
                        "mode": 0,
                    }
                ]
            }
        )
        nodes.append({"mesh": len(gltf_meshes) - 1})

    materials = []
    for verts, faces, rgb in meshes:
        verts = np.ascontiguousarray(verts, np.float32)
        faces = np.ascontiguousarray(faces, np.uint32)
        v_view = add_view(verts.tobytes(), ARRAY_BUFFER)
        v_acc = add_accessor(
            v_view, FLOAT, len(verts), "VEC3",
            (verts.min(0).tolist(), verts.max(0).tolist()),
        )
        f_view = add_view(faces.tobytes(), ELEMENT_BUFFER)
        f_acc = add_accessor(f_view, UINT, faces.size, "SCALAR")
        materials.append(
            {
                "pbrMetallicRoughness": {
                    "baseColorFactor": [rgb[0] / 255, rgb[1] / 255, rgb[2] / 255, 1.0],
                    "metallicFactor": 0.0,
                    "roughnessFactor": 1.0,
                },
                "doubleSided": True,
            }
        )
        gltf_meshes.append(
            {
                "primitives": [
                    {
                        "attributes": {"POSITION": v_acc},
                        "indices": f_acc,
                        "mode": 4,
                        "material": len(materials) - 1,
                    }
                ]
            }
        )
        nodes.append({"mesh": len(gltf_meshes) - 1})

    gltf = {
        # the JAX package's generator name: both packages write the same bytes
        "asset": {"version": "2.0", "generator": "omnivggt_tpu"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": gltf_meshes,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "buffers": [{"byteLength": sum(len(p) for p in bin_parts)}],
    }
    if materials:
        gltf["materials"] = materials

    json_bytes = _pad4(json.dumps(gltf, separators=(",", ":")).encode(), b" ")
    bin_bytes = b"".join(bin_parts)

    def emit(f):
        total = 12 + 8 + len(json_bytes) + 8 + len(bin_bytes)
        f.write(struct.pack("<III", 0x46546C67, 2, total))  # glTF magic
        f.write(struct.pack("<II", len(json_bytes), 0x4E4F534A))  # JSON
        f.write(json_bytes)
        f.write(struct.pack("<II", len(bin_bytes), 0x004E4942))  # BIN
        f.write(bin_bytes)

    if hasattr(path, "write"):  # file-like (e.g. an HTTP response stream)
        emit(path)
    else:
        with open(path, "wb") as f:
            emit(f)


# ---------------------------------------------------------------------------
# Scene assembly
# ---------------------------------------------------------------------------


def _rot(axis: str, deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4)
    if axis == "x":
        m[1:3, 1:3] = [[c, -s], [s, c]]
    elif axis == "y":
        m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    else:
        m[:2, :2] = [[c, -s], [s, c]]
    return m


def get_opengl_conversion_matrix() -> np.ndarray:
    m = np.eye(4)
    m[1, 1] = m[2, 2] = -1.0
    return m


def _transform_points(T: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ T[:3, :3].T + T[:3, 3]


def camera_frustum_mesh(
    cam_to_world: np.ndarray, scene_scale: float, n_sides: int = 8
) -> Tuple[np.ndarray, np.ndarray]:
    """A cone-style camera marker (apex at the optical centre, opening along
    +z in OpenCV convention after the OpenGL flip), double-shelled for
    visibility."""
    w = scene_scale * 0.05
    h = scene_scale * 0.1
    ang = np.linspace(0, 2 * np.pi, n_sides, endpoint=False) + np.pi / n_sides
    ring = np.stack([w * np.cos(ang), w * np.sin(ang), np.full(n_sides, -h)], axis=1)
    verts = np.concatenate([np.zeros((1, 3)), ring], axis=0)

    faces = []
    for i in range(n_sides):
        j = 1 + i
        k = 1 + (i + 1) % n_sides
        faces.append((0, j, k))
        faces.append((0, k, j))  # double-sided
    # base fan
    for i in range(1, n_sides - 1):
        faces.append((1, 1 + i, 2 + i))
        faces.append((2 + i, 1 + i, 1))
    faces = np.asarray(faces, np.uint32)

    T = cam_to_world @ get_opengl_conversion_matrix()
    # shift so the ring (image plane) sits in front of the optical centre
    shift = np.eye(4)
    shift[2, 3] = -h
    verts = _transform_points(T @ shift, verts)
    return verts.astype(np.float32), faces


def _rainbow(t: float) -> Tuple[int, int, int]:
    """gist_rainbow-style colormap without matplotlib."""
    import colorsys

    r, g, b = colorsys.hsv_to_rgb(t * 0.9, 1.0, 1.0)
    return int(255 * r), int(255 * g), int(255 * b)


def predictions_to_glb_data(
    predictions: dict,
    conf_thres: float = 50.0,
    filter_by_frames: str = "all",
    mask_black_bg: bool = False,
    mask_white_bg: bool = False,
    show_cam: bool = True,
    mask_sky: bool = False,
    image_folder: Optional[str] = None,
    target_dir: Optional[str] = None,
    prediction_mode: str = "Predicted Pointmap",
):
    """Assemble filtered (points, colors, camera meshes) from a prediction dict
    (numpy, batch dim removed) under the reference's filtering rules: keep
    conf >= the conf_thres percentile and conf > 1e-5 (conf_thres 0 keeps
    the second test alone)."""
    if not isinstance(predictions, dict):
        raise ValueError("predictions must be a dictionary")
    if conf_thres is None:
        conf_thres = 10.0

    selected_frame_idx = None
    if filter_by_frames not in ("all", "All"):
        try:
            selected_frame_idx = int(str(filter_by_frames).split(":")[0])
        except (ValueError, IndexError):
            pass

    if "Pointmap" in prediction_mode and "world_points" in predictions:
        pts = predictions["world_points"]
        conf = predictions.get("world_points_conf", np.ones(pts.shape[:-1]))
    else:
        pts = predictions["world_points_from_depth"]
        conf = predictions.get("depth_conf", np.ones(pts.shape[:-1]))

    images = predictions["images"]
    camera_matrices = predictions["extrinsic"]

    if mask_sky and image_folder is not None:
        from omnivggt_tpu_torch.viz.sky import sky_masks_for_folder

        # the folder can hold more stills than were processed: mask only the
        # S frames in the predictions
        sky = sky_masks_for_folder(
            image_folder, conf.shape[-2:], cache_dir=target_dir,
            limit=conf.shape[0],
        )
        conf = conf * (sky > 0.1).astype(np.float32)

    if selected_frame_idx is not None:
        pts = pts[selected_frame_idx][None]
        conf = conf[selected_frame_idx][None]
        images = images[selected_frame_idx][None]
        camera_matrices = camera_matrices[selected_frame_idx][None]

    vertices = pts.reshape(-1, 3)
    if images.ndim == 4 and images.shape[1] == 3:  # NCHW
        colors = np.transpose(images, (0, 2, 3, 1))
    else:
        colors = images
    colors = (colors.reshape(-1, 3) * 255).astype(np.uint8)

    conf_flat = conf.reshape(-1)
    threshold = 0.0 if conf_thres == 0.0 else np.percentile(conf_flat, conf_thres)
    mask = (conf_flat >= threshold) & (conf_flat > 1e-5)
    if mask_black_bg:
        mask &= colors.sum(axis=1) >= 16
    if mask_white_bg:
        mask &= ~((colors[:, 0] > 240) & (colors[:, 1] > 240) & (colors[:, 2] > 240))

    vertices = vertices[mask]
    colors = colors[mask]

    if vertices.size == 0:
        vertices = np.array([[1.0, 0, 0]], np.float32)
        colors = np.array([[255, 255, 255]], np.uint8)
        scene_scale = 1.0
    else:
        lo = np.percentile(vertices, 5, axis=0)
        hi = np.percentile(vertices, 95, axis=0)
        scene_scale = float(np.linalg.norm(hi - lo))

    # camera extrinsics -> homogeneous
    n_cam = len(camera_matrices)
    E = np.zeros((n_cam, 4, 4))
    E[:, :3, :4] = camera_matrices
    E[:, 3, 3] = 1

    meshes = []
    if show_cam:
        for i in range(n_cam):
            c2w = np.linalg.inv(E[i])
            verts, faces = camera_frustum_mesh(c2w, scene_scale)
            meshes.append((verts, faces, _rainbow(i / max(n_cam, 1))))

    # align to the first camera's view, OpenGL convention (a scene
    # transform, applied to all geometry)
    align = np.linalg.inv(E[0]) @ get_opengl_conversion_matrix() @ _rot("y", 180)
    vertices = _transform_points(align, vertices).astype(np.float32)
    meshes = [
        (_transform_points(align, v).astype(np.float32), f, c) for v, f, c in meshes
    ]
    return vertices, colors, meshes


def predictions_to_glb(predictions: dict, path: str, **kwargs) -> str:
    """Filter predictions and write the GLB file. Returns `path`."""
    vertices, colors, meshes = predictions_to_glb_data(predictions, **kwargs)
    write_glb(path, vertices, colors, meshes)
    return path
