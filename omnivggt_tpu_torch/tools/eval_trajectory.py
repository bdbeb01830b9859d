"""Trajectory evaluation CLI of the PyTorch port (counterpart of
tools/eval_trajectory.py; the same metrics), the command-line front end for
eval/trajectory.py.

Two modes:

  1. File vs file: compare a predicted trajectory against ground truth
     (TUM / Sintel / Replica / TartanAir formats); host numpy only:
        python -m omnivggt_tpu_torch.tools.eval_trajectory --pred pred.txt \\
            --gt gt.txt --pred_format tum --gt_format tum --out metrics.txt

  2. Model in the loop: run the model on a scene folder on --device
     (default cuda, which must exist; --device cpu runs the kernels' plain
     versions on the CPU) and score its predicted camera trajectory against
     the scene's GT cameras:
        python -m omnivggt_tpu_torch.tools.eval_trajectory \\
            --image_folder scene/images --gt_cameras scene/cameras \\
            [--checkpoint OmniVGGT.safetensors | --tiny]

Prints ATE RMSE, RPE trans/rot, and pose AUC@{5,10,30} as JSON; optionally
writes the reference-style metrics file and a trajectory plot (matplotlib).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _expand_c2w(ex_w2c: np.ndarray) -> np.ndarray:
    """(N, 3, 4) w2c -> (N, 4, 4) c2w."""
    N = ex_w2c.shape[0]
    E = np.tile(np.eye(4, dtype=np.float64), (N, 1, 1))
    E[:, :3] = ex_w2c
    return np.linalg.inv(E)


def _model_trajectory(args) -> tuple:
    """Run the model on a scene; returns (pred_c2w, gt_c2w)."""
    import torch

    from omnivggt_tpu_torch.config import OmniVGGTConfig, tiny_test_config
    from omnivggt_tpu_torch.data.loader import load_images_and_cameras
    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
    from omnivggt_tpu_torch.utils.device import resolve_device
    from omnivggt_tpu_torch.utils.geometry import pose_encoding_to_extri_intri

    device = resolve_device(args.device)
    images, ex, K, *_, c_idx = load_images_and_cameras(
        args.image_folder, camera_folder=args.gt_cameras,
        target_size=args.target_size,
    )
    if len(c_idx) != images.shape[0]:
        raise SystemExit(
            f"GT cameras cover {len(c_idx)}/{images.shape[0]} frames; "
            "every frame needs GT for trajectory eval"
        )
    if args.checkpoint:
        model = OmniVGGT.from_safetensors(args.checkpoint, device=device)
    else:
        cfg = tiny_test_config() if args.tiny else OmniVGGTConfig()
        model = OmniVGGT(cfg, device=device)
    model.eval()
    H, W = images.shape[1:3]
    with torch.inference_mode():
        preds = model(images)
        pred_w2c, _ = pose_encoding_to_extri_intri(preds["pose_enc"], (H, W))
    return _expand_c2w(pred_w2c[0].float().cpu().numpy()), _expand_c2w(ex[0])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pred", help="predicted trajectory file")
    ap.add_argument("--gt", help="ground-truth trajectory file")
    ap.add_argument("--pred_format", default="tum",
                    choices=["tum", "sintel", "replica", "tartanair"])
    ap.add_argument("--gt_format", default="tum",
                    choices=["tum", "sintel", "replica", "tartanair"])
    ap.add_argument("--image_folder", help="scene images (model mode)")
    ap.add_argument("--gt_cameras", help="scene GT camera .txt folder")
    ap.add_argument("--checkpoint", help="OmniVGGT .safetensors")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny random-weight config (CPU smoke mode)")
    ap.add_argument("--device", default="cuda",
                    help="model mode: cuda (default; fails without a CUDA device) or cpu")
    ap.add_argument("--target_size", type=int, default=518)
    ap.add_argument("--skip", type=int, default=0)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--out", help="write a reference-style metrics file")
    ap.add_argument("--plot", help="write a trajectory plot (png)")
    args = ap.parse_args(argv)

    from omnivggt_tpu_torch.eval.trajectory import (
        eval_metrics, load_traj, plot_trajectory, pose_auc,
        write_metrics_file,
    )

    if args.image_folder:
        if not args.gt_cameras:
            raise SystemExit("--image_folder mode needs --gt_cameras")
        pred, gt = _model_trajectory(args)
        seq = os.path.basename(args.image_folder.rstrip("/"))
    elif args.pred and args.gt:
        pred, _ = load_traj(args.pred, args.pred_format,
                            skip=args.skip, stride=args.stride)
        gt, _ = load_traj(args.gt, args.gt_format,
                          skip=args.skip, stride=args.stride)
        n = min(len(pred), len(gt))
        pred, gt = pred[:n], gt[:n]
        seq = os.path.basename(args.pred)
    else:
        raise SystemExit("need --pred/--gt files OR --image_folder/--gt_cameras")

    metrics = eval_metrics(pred, gt)
    metrics.update(pose_auc(pred, gt))
    print(json.dumps({"seq": seq, "frames": len(pred), **metrics}, indent=2))

    if args.out:
        write_metrics_file(metrics, args.out, seq=seq)
        print(f"wrote {args.out}")
    if args.plot:
        plot_trajectory(pred, gt, title=seq, filename=args.plot)
        print(f"wrote {args.plot}")
    return metrics


if __name__ == "__main__":
    main()
