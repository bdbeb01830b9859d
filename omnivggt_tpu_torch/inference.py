"""OmniVGGT inference CLI for the PyTorch port (counterpart of inference.py).

Loads a scene folder (images + optional per-frame camera .txt and depth
.npy/.png), runs one forward pass on --device (default cuda, which must
exist; --device cpu runs the kernels' plain versions on the CPU), decodes
the camera poses and unprojects the depth maps, optionally exports a GLB
(--save_glb; default path <parent of image_folder>/scene.glb), and serves the
interactive 3D viewer unless --no_viewer is given (--background_mode: on a
daemon thread, and main returns).

    python -m omnivggt_tpu_torch.inference --image_folder scene/images \
        --camera_folder scene/cameras --checkpoint OmniVGGT.safetensors --save_glb
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="OmniVGGT multi-view 3D reconstruction (PyTorch)")
    p.add_argument("--image_folder", type=str, required=True, help="folder of input images")
    p.add_argument("--depth_folder", type=str, default=None, help="optional per-frame depth (.npy/.png)")
    p.add_argument("--camera_folder", type=str, default=None, help="optional per-frame camera .txt files")
    p.add_argument("--target_size", type=int, default=518, help="resize width in px")
    p.add_argument("--use_point_map", action="store_true",
                   help="visualize the point-map head output instead of depth unprojection")
    p.add_argument("--mask_sky", action="store_true", help="mask sky in the GLB export")
    p.add_argument("--mask_black_bg", action="store_true")
    p.add_argument("--mask_white_bg", action="store_true")
    p.add_argument("--conf_threshold", type=float, default=25.0,
                   help="confidence percentile filter")
    p.add_argument("--port", type=int, default=8080, help="viewer port")
    p.add_argument("--background_mode", action="store_true",
                   help="run the viewer in a daemon thread")
    p.add_argument("--save_glb", action="store_true", help="export scene .glb")
    p.add_argument("--glb_path", type=str, default=None)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="path to a reference safetensors checkpoint")
    p.add_argument("--no_viewer", action="store_true", help="skip the interactive viewer")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a CUDA device) or cpu")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random-weight config (CPU smoke testing)")
    p.add_argument("--compress_trunk", action="store_true",
                   help="store trunk weights in bf16 (checkpoint.cast_trunk_params)")
    p.add_argument("--fp32_heads", action="store_true",
                   help="reference-parity mode: fp32 dense heads and exact-erf "
                        "GELU, no certification ladder at checkpoint load")
    p.add_argument("--quantising_rungs", action="store_true",
                   help="let the ladder also certify the modes that quantise "
                        "(W8A8 trunk, int8 attention scores, W8A8 head convs). "
                        "Off by default: on an H100 each of them runs slower "
                        "than the bf16 default so far (PERF.md)")
    p.add_argument("--no_int8_trunk", action="store_true",
                   help="with --quantising_rungs: drop the W8A8 int8 trunk from "
                        "the certified modes (bf16 heads / tanh GELU stay)")
    p.add_argument("--no_attn_quant", action="store_true",
                   help="with --quantising_rungs: run the attention scores in "
                        "bf16 even where the ladder certified int8 scores")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.target_size % 14:
        raise SystemExit(
            f"--target_size must be a multiple of the 14-px patch (got "
            f"{args.target_size}; nearest: {round(args.target_size / 14) * 14})"
        )
    import torch

    from omnivggt_tpu_torch.checkpoint import cast_trunk_params
    from omnivggt_tpu_torch.config import OmniVGGTConfig, tiny_test_config
    from omnivggt_tpu_torch.data.loader import load_images_and_cameras
    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
    from omnivggt_tpu_torch.utils.geometry import (
        pose_encoding_to_extri_intri,
        unproject_depth_map_to_point_map,
    )
    from omnivggt_tpu_torch.utils.platform import ensure_platform

    device = ensure_platform(args.device)  # TF32 off: the fp32 heads keep full fp32
    print(f"device: {torch.cuda.get_device_name(0) if device.type == 'cuda' else 'cpu'}")
    if args.tiny:
        model = OmniVGGT(tiny_test_config(), device=device)
    elif args.checkpoint:
        print(f"loading checkpoint {args.checkpoint} ...")
        # "auto" certifies the fast serving modes on a probe batch and keeps
        # the verdict next to the checkpoint (models/omnivggt.certify_fast_modes)
        model = OmniVGGT.from_safetensors(
            args.checkpoint, device=device,
            head_dtype="float32" if args.fp32_heads else "auto",
            quantising_rungs=args.quantising_rungs,
        )
        overrides = {}
        if args.no_int8_trunk and model.config.trunk_quant != "none":
            overrides["trunk_quant"] = "none"
        if args.no_attn_quant and model.config.attn_quant != "none":
            overrides["attn_quant"] = "none"
        if overrides:
            import dataclasses

            model.config = dataclasses.replace(model.config, **overrides)
        print(f"head dtype: {model.config.head_dtype}  approx_gelu: {model.config.approx_gelu}  "
              f"trunk_quant: {model.config.trunk_quant}  attn_quant: {model.config.attn_quant}  "
              f"head_quant: {model.config.head_quant}")
    else:
        print(
            "WARNING: no --checkpoint given — running with random weights "
            "(outputs are structurally valid but not meaningful)."
        )
        model = OmniVGGT(OmniVGGTConfig(), device=device)
    if args.compress_trunk:
        cast_trunk_params(model)
    model.eval()

    images, extrinsics, intrinsics, depths, masks, depth_idx, camera_idx = (
        load_images_and_cameras(
            args.image_folder,
            camera_folder=args.camera_folder,
            depth_folder=args.depth_folder,
            target_size=args.target_size,
        )
    )
    if args.tiny:
        # the tiny config wants tiny images: stride-subsample to its img_size
        sz = model.config.img_size
        step = max(images.shape[1] // sz, 1)
        images = images[:, ::step, ::step][:, :sz, :sz]
        depths = depths[:, :, ::step, ::step][:, :, :sz, :sz]
        masks = masks[:, :, ::step, ::step][:, :, :sz, :sz]
    S, H, W = images.shape[:3]
    print(f"running inference on {S} frames at {H}x{W} ...")

    with torch.inference_mode():
        predictions = model(
            images,
            extrinsics=extrinsics,
            intrinsics=intrinsics,
            depth=depths,
            mask=masks,
            depth_gt_index=depth_idx,
            camera_gt_index=camera_idx,
        )
        extrinsic, intrinsic = pose_encoding_to_extri_intri(predictions["pose_enc"], (H, W))

    preds = {
        k: v[0].float().cpu().numpy()
        for k, v in predictions.items()
        if k != "pose_enc_list"
    }
    preds["extrinsic"] = extrinsic[0].cpu().numpy()
    preds["intrinsic"] = intrinsic[0].cpu().numpy()
    preds["world_points_from_depth"] = unproject_depth_map_to_point_map(
        preds["depth"], preds["extrinsic"], preds["intrinsic"]
    )
    for k in ("pose_enc", "depth", "world_points", "world_points_from_depth"):
        v = preds[k]
        print(f"{k}: shape {v.shape}, finite {bool(np.isfinite(v).all())}")

    if args.save_glb:
        from omnivggt_tpu_torch.viz.glb import predictions_to_glb

        glb_path = args.glb_path or os.path.join(
            os.path.dirname(args.image_folder.rstrip("/")) or ".", "scene.glb"
        )
        predictions_to_glb(
            preds,
            glb_path,
            conf_thres=args.conf_threshold,
            mask_black_bg=args.mask_black_bg,
            mask_white_bg=args.mask_white_bg,
            mask_sky=args.mask_sky,
            image_folder=args.image_folder,
            target_dir=os.path.dirname(glb_path) or ".",
            prediction_mode="Predicted Pointmap" if args.use_point_map else "Depth",
        )
        print(f"saved {glb_path}")

    if not args.no_viewer:
        from omnivggt_tpu_torch.viz.server import serve_scene

        serve_scene(
            preds,
            port=args.port,
            init_conf_threshold=args.conf_threshold,
            background_mode=args.background_mode,
            use_point_map=args.use_point_map,
            mask_black_bg=args.mask_black_bg,
            mask_white_bg=args.mask_white_bg,
        )
    return preds


if __name__ == "__main__":
    main()
