"""Quick start: reconstruct a scene folder and export a GLB (counterpart of
examples/quickstart.py), through the port's top-level API.

    python -m omnivggt_tpu_torch.examples.quickstart scene/images \\
        [--camera_folder scene/cameras] [--checkpoint OmniVGGT.safetensors] [--out scene.glb]

Runs on the card (--device cpu for the CPU). Reading the image folder
needs PIL.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description="reconstruct a scene folder into a GLB")
    ap.add_argument("image_folder")
    ap.add_argument("--camera_folder", default=None)
    ap.add_argument("--checkpoint", default=None, help="reference .safetensors (default: random weights)")
    ap.add_argument("--out", default="scene.glb")
    ap.add_argument("--target_size", type=int, default=518)
    ap.add_argument("--tiny", action="store_true", help="tiny random-weight config (CPU smoke runs)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a CUDA device) or cpu")
    args = ap.parse_args(argv)

    from omnivggt_tpu_torch.utils.platform import ensure_platform

    device = ensure_platform(args.device)

    import torch

    from omnivggt_tpu_torch import OmniVGGT, OmniVGGTConfig, load_images_and_cameras
    from omnivggt_tpu_torch.config import tiny_test_config
    from omnivggt_tpu_torch.utils.geometry import (
        pose_encoding_to_extri_intri,
        unproject_depth_map_to_point_map,
    )
    from omnivggt_tpu_torch.viz.glb import predictions_to_glb

    images, extrinsics, intrinsics, depths, masks, depth_idx, camera_idx = (
        load_images_and_cameras(args.image_folder, camera_folder=args.camera_folder,
                                target_size=args.target_size)
    )
    if args.checkpoint:
        model = OmniVGGT.from_safetensors(args.checkpoint, device=device)
    else:
        model = OmniVGGT(tiny_test_config() if args.tiny else OmniVGGTConfig(), device=device)
    with torch.inference_mode():
        predictions = model.eval()(
            images, extrinsics=extrinsics, intrinsics=intrinsics, depth=depths, mask=masks,
            depth_gt_index=depth_idx, camera_gt_index=camera_idx,
        )
        H, W = images.shape[1:3]
        extrinsic, intrinsic = pose_encoding_to_extri_intri(predictions["pose_enc"], (H, W))

    preds = {k: v[0].float().cpu().numpy() for k, v in predictions.items() if k != "pose_enc_list"}
    preds["extrinsic"] = extrinsic[0].cpu().numpy()
    preds["intrinsic"] = intrinsic[0].cpu().numpy()
    preds["world_points_from_depth"] = unproject_depth_map_to_point_map(
        preds["depth"], preds["extrinsic"], preds["intrinsic"]
    )
    out = predictions_to_glb(preds, args.out, conf_thres=25.0)
    print(f"wrote {out}")
    return preds


if __name__ == "__main__":
    main()
