"""Serving quick start: start the inference server and round-trip a request
(counterpart of examples/serve.py), through the port's top-level API.

    python -m omnivggt_tpu_torch.examples.serve checkpoint.safetensors   # on the card
    python -m omnivggt_tpu_torch.examples.serve --tiny                   # CPU demo

Starts the HTTP endpoint (serving.serve) with request batching and bearer
auth, posts a scene as .npz to /infer, prints the returned prediction
shapes, then fetches a GLB export from /infer_glb.
"""

from __future__ import annotations

import argparse
import io
import urllib.request


def main(argv=None):
    ap = argparse.ArgumentParser(description="serve the model and send it one scene")
    ap.add_argument("checkpoint", nargs="?", help="reference .safetensors")
    ap.add_argument("--tiny", action="store_true", help="the tiny config, served on the CPU")
    args = ap.parse_args(argv)
    if not args.tiny and not args.checkpoint:
        raise SystemExit(__doc__)

    from omnivggt_tpu_torch.utils.platform import ensure_platform

    device = ensure_platform("cpu" if args.tiny else None)

    import numpy as np

    from omnivggt_tpu_torch import InferenceSession, OmniVGGT, serve
    from omnivggt_tpu_torch.config import tiny_test_config

    if args.tiny:
        model, size = OmniVGGT(tiny_test_config(), device=device), 28
    else:
        model, size = OmniVGGT.from_safetensors(args.checkpoint, device=device), 518

    session = InferenceSession(model, buckets=(2, 4, 8, 16), compress_trunk=True)
    httpd, _ = serve(session, port=0, background=True, token="demo", batch_window_ms=4.0)
    port = httpd.server_address[1]
    print(f"server on :{port}")
    try:
        rng = np.random.default_rng(0)
        buf = io.BytesIO()
        np.savez(buf, images=rng.uniform(size=(3, size, size, 3)).astype(np.float32))
        headers = {"Authorization": "Bearer demo"}
        req = urllib.request.Request(f"http://localhost:{port}/infer", data=buf.getvalue(),
                                     method="POST", headers=headers)
        with urllib.request.urlopen(req, timeout=600) as resp:
            preds = dict(np.load(io.BytesIO(resp.read())))
            print(f"inference {resp.headers['X-Inference-Seconds']}s:")
            for k, v in preds.items():
                print(f"  {k}: {v.shape}")
        req = urllib.request.Request(f"http://localhost:{port}/infer_glb", data=buf.getvalue(),
                                     method="POST", headers=headers)
        with urllib.request.urlopen(req, timeout=600) as resp:
            glb = resp.read()
        if glb[:4] != b"glTF":
            raise RuntimeError("/infer_glb did not answer a GLB")
        print(f"GLB export: {len(glb)} bytes")
    finally:
        httpd.shutdown()
        httpd.server_close()
    return preds, glb


if __name__ == "__main__":
    main()
