"""Build streaming training shards from scene folders (counterpart of
tools/make_shards.py).

Preprocess once, train many times: samples are drawn from a SceneDataset
(example-layout folders, ScanNet scenes and CO3D sequences, through the
format dispatcher) and written into tar shards that the training CLI
streams (`--shards`, data/streaming.py). This is host-only preprocessing in
numpy: it touches no GPU, and its readers need PIL (and OpenCV for the
depth resize), so it runs where the scenes and those libraries are.

    python -m omnivggt_tpu_torch.tools.make_shards --data_root scenes/ \\
        --out shards/ --num_samples 10000 --views 4 [--target_size 518]
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Build streaming training shards")
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--num_samples", type=int, required=True)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--target_size", type=int, default=518)
    ap.add_argument("--samples_per_shard", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np

    from omnivggt_tpu_torch.utils.platform import ensure_platform

    ensure_platform("cpu")  # host-only; TF32 off as at every entry point

    from omnivggt_tpu_torch.data.dataset import SceneDataset
    from omnivggt_tpu_torch.data.streaming import write_shards

    ds = SceneDataset(
        args.data_root, views_per_sample=args.views, target_size=args.target_size, seed=args.seed,
    )
    print(f"{len(ds)} scene(s) under {args.data_root}")
    rng = np.random.default_rng(args.seed)

    def samples():
        for i in range(args.num_samples):
            if i and i % 100 == 0:
                print(f"  {i}/{args.num_samples}")
            yield ds.sample(rng)

    paths = write_shards(samples(), args.out, samples_per_shard=args.samples_per_shard)
    print(f"wrote {args.num_samples} samples into {len(paths)} shard(s) under {args.out}")
    return paths


if __name__ == "__main__":
    main()
